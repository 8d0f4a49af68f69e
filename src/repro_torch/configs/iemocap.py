"""The paper's own IEMOCAP multimodal model (audio LSTM + text LSTM, §VI)."""
DATASET = "iemocap"
MODALITIES = ("audio", "text")
N_CLASSES = 10
