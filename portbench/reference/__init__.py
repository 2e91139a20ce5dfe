"""The check's plain reference: a frozen copy of the port's plain PyTorch
path (`vtgaussian_slam_tpu_torch` at the commit that added this folder):
the modules one tracking, densification, spawn or mapping step goes
through, with their docstrings as the port has them.

Each kernel entry point (`splat_forward`, `splat_backward_pose`,
`splat_backward_vals_rows`, `blend_forward`, `blend_backward`) runs the
plain version of its kernel, in blocks of tile rows so that a full-size
frame fits on one card; nothing here launches a hand-written kernel, and
nothing imports the port, JAX or the JAX package. Later changes to the
port do not reach this copy: it is the yardstick.
"""
