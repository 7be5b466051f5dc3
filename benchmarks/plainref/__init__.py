"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch forms (the modules and names of `gsplatloc_tpu_torch` as they
stood when each was copied), cut to what the benchmark's tracking paths
run, with no kernel, no band mesh and scipy's exact kNN in place of the
port's C++ tree. `pair.py` is the prepare every path shares; each path's
depth target and loop are in `paths/<path>.py`, found by the path's
name. Every wrapper here runs its plain form, on the CPU or the card;
where a docstring names a CUDA kernel, it is the port's kernel that the
plain form stands for. Imports nothing of the port, and takes nothing the
port made.
"""
