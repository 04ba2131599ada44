"""Deployment-side tooling of the port: numpy twins of the reward and
reference-motion math, the 50 Hz policy loop, sim-to-sim inference on the
port's own engine (the fused physics step at one env: the kernel on the
card, its plain version on the CPU) and on MuJoCo C, the sim-to-sim gate
(``sim2sim_check``), the C++ policy runtime bindings, and the interactive
and visual tools: terminal teleop (``teleop``), the live viewer and
joysticks (``viewer``), offscreen video (``render``), obs-trace plots
(``plot_saved_obs``) and the gait viewer (``ref_motion_viewer``).
``mujoco``, matplotlib, PIL, OpenCV and pygame are imported inside the
functions and classes that use them, never at module import.
"""
