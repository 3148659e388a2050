"""Workloads of the JAX package's bench (``bench.py``), for the PyTorch
port's measurements: not part of the library's API, as the JAX package
keeps them in its bench script and not in its library.

- :mod:`.nn_control`: the NN control of the CH macro trained through its
  gradient (``run_train_grad_128``).
- :mod:`.inverse`: the JAX package's training examples, the 32³ Legendre
  fit (``examples/optimize_3d.py``) and the NN-μ fit
  (``examples/optimize_nn.py``).
"""
