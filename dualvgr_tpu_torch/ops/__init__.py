"""The BiLSTM and graph-cycle ops: plain PyTorch versions and CUDA kernels."""
