"""Launch layer: the single-card train steps and the resilient train loop
(:mod:`.train`)."""
