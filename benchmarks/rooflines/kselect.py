"""kselect: the K-cover records select K3 (`kcover_select_kernel`), one
launch a call of `ops.kcover.select_kcover_records`; its calls, the
selections, are its sampling clock and kstep's. Its bound:
bounds.select_bound of the call's own slot buffer, segment table, camera
and sizes."""

HOOKS = [("gsplatloc_tpu_torch.ops.kcover", "select_kcover_records")]
KERNELS = ("kcover_select_kernel",)


def hold(*args, **k):
    return args


def bound(held, window) -> float:
    from bounds import select_bound

    return select_bound(*held[:8])
