"""Running the pipeline over parts of a frame (counterpart of
``drtk_tpu/parallel``): row bands of one frame on one device
(:mod:`~drtk_tpu_torch.parallel.banded`), and row blocks and cameras over
the ranks of a ``torch.distributed`` mesh
(:mod:`~drtk_tpu_torch.parallel.sharding`,
:mod:`~drtk_tpu_torch.parallel.spmd`,
:mod:`~drtk_tpu_torch.parallel.multihost`)."""
