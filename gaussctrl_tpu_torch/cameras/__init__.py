from gaussctrl_tpu_torch.cameras.camera import Cameras, make_cameras, view_matrix  # noqa: F401
