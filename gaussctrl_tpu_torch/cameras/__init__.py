from gaussctrl_tpu_torch.cameras.camera import (Cameras, fov, make_cameras,  # noqa: F401
                                                projection_matrix, view_matrix)
