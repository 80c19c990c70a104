"""Host utilities: the environment config, RLP, telemetry."""
