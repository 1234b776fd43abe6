"""FL engine: the stacked-client round computation and its orchestration."""
