"""The paper's own CREMA-D multimodal model (audio LSTM + image CNN, §VI)."""
DATASET = "crema_d"
MODALITIES = ("audio", "image")
N_CLASSES = 6
