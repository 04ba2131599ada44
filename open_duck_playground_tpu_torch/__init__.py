"""PyTorch/CUDA port of the Open Duck Mini v2 locomotion framework.

A second package beside ``open_duck_playground_tpu`` (the JAX reference,
which stays as it is). Its module tree mirrors the JAX package's, so each
counterpart is found by name:

- ``mjcf``     : MJCF-subset model compiler (numpy, cast to torch at the end)
- ``ops``      : the physics step: ``lane_physics`` (plain PyTorch, runs on
                 ``(B,)`` tensors) and ``cuda_step`` (the hand-written CUDA
                 kernel for Hopper, with the plain version as its CPU path)
- ``models``   : robot constants and asset lookup
- ``envs``     : Joystick task, rewards, domain randomization, train wrapper
- ``train``    : PPO networks, optimizer, trainer, checkpoints, runner CLI
- ``export``   : ONNX writer, checker and numpy interpreter
- ``interop``  : numpy carry-across from the JAX package's models, states,
                 parameters and optimizer states

Imports ``torch``, ``numpy`` and ``scipy``; never ``jax``.
"""

__version__ = "0.1.0"
