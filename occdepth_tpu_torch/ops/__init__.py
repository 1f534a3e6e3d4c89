"""The port's hand-written kernels, one wrapper module each."""


def launch_counters() -> dict:
    """name -> the wrapper of each hand-written kernel.  Its `.launches`
    counts the kernel's launches, and its `.paths`, where it has one, the
    launches of each of its kernels.  The serving pipeline's stage graphs
    add a captured stage's launches on every replay (serving/pipeline.py)."""
    from .conv2d_shift import conv3x3, to_padded_channels_last
    from .crp_matmul import crp_relation_matmul
    from .dw_conv import dw_filter_grad
    from .flosp_gather import flosp_stereo_lift, flosp_stereo_lift_backward
    from .matmul_probe import matmul_probe
    from .row_gather import row_gather
    from .stereo_fuse import stereo_cosine_fuse, stereo_cosine_fuse_backward

    return {"stereo_cosine_fuse": stereo_cosine_fuse,
            "stereo_cosine_fuse_backward": stereo_cosine_fuse_backward,
            "flosp_stereo_lift": flosp_stereo_lift,
            "flosp_stereo_lift_backward": flosp_stereo_lift_backward,
            "pack_nhwc": to_padded_channels_last,
            "crp_relation_matmul": crp_relation_matmul,
            "conv3x3": conv3x3, "dw_filter_grad": dw_filter_grad,
            "row_gather": row_gather, "matmul_probe": matmul_probe}
