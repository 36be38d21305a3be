"""Running the pipeline over parts of a frame (counterpart of
``drtk_tpu/parallel``): row bands of one frame on one device."""
