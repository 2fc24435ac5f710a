"""Model families: the hybrid STGCN->LSTM forecaster and the standalone STGCN."""
