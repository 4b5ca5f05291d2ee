"""Cost and roofline analysis of the port's steps (the dry-run's counters and
the H100 roofline)."""
