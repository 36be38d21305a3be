"""The yardstick of the ``drtk_tpu_torch`` benchmark: the run of one cell
(:mod:`drtkbench.harness`), its scenes, its device trace, the card's
published peaks and the comparison that decides ``correct``. Cells,
configurations, entries, per-layer metrics and bounds are files of their
own under ``benchmark/``, found by name."""
