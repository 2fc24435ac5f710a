"""PyTorch/CUDA port of weatherforecast_stgcn_maml_tpu: the forecast and
validate serving path, with hand-written Hopper kernels for the fused GCN
encoder stack and the fused LSTM stack. Imports torch and numpy, never jax."""
