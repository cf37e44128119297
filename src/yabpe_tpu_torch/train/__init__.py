"""Training: config, model container, merge loop, orchestration."""
