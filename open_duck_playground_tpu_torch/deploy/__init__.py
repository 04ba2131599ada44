"""Deployment-side tooling of the port: numpy twins of the reward and
reference-motion math, the 50 Hz policy loop, sim-to-sim inference on the
port's own engine (the fused physics step at one env: the kernel on the
card, its plain version on the CPU) and on MuJoCo C, the sim-to-sim gate
(``sim2sim_check``), and the C++ policy runtime bindings. ``mujoco`` is
imported inside the classes that use it, never at module import.
"""
