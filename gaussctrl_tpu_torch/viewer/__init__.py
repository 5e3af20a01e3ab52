"""Interactive scene viewer (the `ns-viewer` role)."""

from gaussctrl_tpu_torch.viewer.server import ViewerServer  # noqa: F401
