"""Host-side utilities: liveness heartbeat, phase timers, device traces."""
