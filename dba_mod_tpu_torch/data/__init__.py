"""Data layer: host-side ingestion + partitioning, device-resident batching
(port of dba_mod_tpu/data, numpy only)."""
