"""kstep: the K-cover step, K1 (`kcover_step_fwd_kernel`) and K2
(`kcover_step_bwd_kernel` and its fixed-order reduction `sum12_kernel`),
one launch of each a call of `ops.kcover.kcover_step_fwd`, held while
kselect's selections count 1, 2, 4, 8, ... (the steps of those covers).
Its bound: bounds.step_bounds of the call's own cover buffer and camera,
K1's and K2's together."""

HOOKS = [("gsplatloc_tpu_torch.ops.kcover", "kcover_step_fwd")]
KERNELS = ("kcover_step_fwd_kernel", "kcover_step_bwd_kernel",
           "sum12_kernel")
CLOCK = "kselect"


def hold(kbuf, cam, *a, **k):
    return kbuf, cam


def bound(held, window) -> float:
    from bounds import step_bounds

    kbuf, cam = held
    w, h = window.image_wh
    b1, b2 = step_bounds(kbuf, cam, -(-h // 16), -(-w // 128),
                         window.tracking.near_plane,
                         window.tracking.far_plane)
    return b1 + b2
