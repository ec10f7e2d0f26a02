"""Host-side utilities of the port: checkpoints (:mod:`.checkpoint`) and
per-stage host timings (:mod:`.trace`)."""
