"""Pipeline orchestration: the GaussCtrl editing method."""

from gaussctrl_tpu_torch.pipeline.gaussctrl import (  # noqa: F401
    GaussCtrlConfig, GaussCtrlPipeline, depth_to_disparity, select_ref_views,
)
