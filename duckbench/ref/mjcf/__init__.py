"""MJCF-subset model compiler: XML + STL + PNG assets -> flat device arrays.

This replaces the reference's dependency on the MuJoCo C compiler
(`mujoco.MjModel.from_xml_string`, reference base.py:53) with a pure-Python
compiler for the MJCF subset exercised by the Open Duck Mini v2 scenes:
bodies/hinge+free joints/mesh+plane+hfield geoms/sites/position actuators/
sensors/keyframes/defaults/includes.
"""

from duckbench.ref.mjcf.compiler import compile_mjcf  # noqa: F401
