"""Training of the port: state, schedule, the generator-only trainer and
checkpoints."""
