"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

K1 `splat_blend.blend`, K2 `flash_attention.flash_attention_t` and K3
`flash_attention.cross_view_attention`. Each wrapper adds one to its entry
in `launch_counts` where it launches its kernel, and nowhere else.
"""

launch_counts = {
    "splat_blend_fwd": 0,
    "flash_attention_t": 0,
    "cross_view_attention": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
