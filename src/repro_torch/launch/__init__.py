"""Launch layer: the single-card train steps (:mod:`.train`)."""
