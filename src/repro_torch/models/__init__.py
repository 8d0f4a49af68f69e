"""The paper's LSTM/CNN submodels on per-client parameter stacks."""
