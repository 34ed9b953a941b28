"""Tensor ops of the port. Each module mirrors the JAX package's module of
the same name; ``cuda_pool`` holds the hand-written CUDA pair core
(forward and backward) that replaces ``pallas_pool``, ``cuda_lstm`` the
whole-loop LSTM recurrence (forward and backward) that replaces
``pallas_fused``, ``cuda_lstm_proj`` the LSTM with its input projection in
the kernel (forward and backward) that replaces ``pallas_lstm``."""
