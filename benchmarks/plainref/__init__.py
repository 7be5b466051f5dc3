"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch forms on the K-cover tracking path (the modules and names of
`gsplatloc_tpu_torch` as they stood when the benchmark was defined), cut
to what that path runs, with no kernel, no band mesh and scipy's exact
kNN in place of the port's C++ tree. Every wrapper here runs its plain
form, on the CPU or the card; where a docstring names a CUDA kernel, it
is the port's kernel that the plain form stands for. Imports nothing of
the port, and takes nothing the port made.
"""
