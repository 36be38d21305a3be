"""Camera and indexing utilities (counterpart of ``drtk_tpu/utils``)."""

from drtk_tpu_torch.utils.indexing import index
from drtk_tpu_torch.utils.projection import project_pinhole, project_points

__all__ = ["index", "project_pinhole", "project_points"]
