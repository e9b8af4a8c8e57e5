"""Runtime probes of the serving path: the §12 fault-injection harness."""
