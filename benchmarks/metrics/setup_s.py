"""setup_s: process start to the window's start (imports, CUDA context,
kernel and kNN libraries, frame cache, clip folders, one warm pair), s."""


def read(rec):
    return rec.setup_s
