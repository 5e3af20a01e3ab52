"""Host-side data: transforms.json parsing, PLY IO, the view cache."""

from gaussctrl_tpu_torch.data.dataparser import (  # noqa: F401
    DataparserConfig, DataparserOutputs, parse_dataset)
from gaussctrl_tpu_torch.data.ply import read_ply  # noqa: F401
from gaussctrl_tpu_torch.data.datamanager import (  # noqa: F401
    DataManager, DataManagerConfig)
