"""Host-side data pipeline (datasets, sampling, batching); the counterpart
of ``loftr_tpu.data``."""
from loftr_tpu_torch.data.scannet import ScanNetDataset
from loftr_tpu_torch.data.megadepth import MegaDepthDataset
from loftr_tpu_torch.data.sampler import SceneBalancedSampler
from loftr_tpu_torch.data.loader import DataLoader, collate_matchinput
from loftr_tpu_torch.data.sharding import get_local_split

__all__ = ["ScanNetDataset", "MegaDepthDataset", "SceneBalancedSampler",
           "DataLoader", "collate_matchinput", "get_local_split"]
