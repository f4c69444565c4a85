"""Seconds from the start of the process to the start of the window:
imports, CUDA, the kernel library (built by nvcc in a checkout's first
run), the circuit made and compiled, A's upload, one warm round."""


def read(run):
    return run.setup_s
