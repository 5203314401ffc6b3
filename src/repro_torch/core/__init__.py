"""SpaRW core: config, warping, schedule, flat ray batches, the engine."""
