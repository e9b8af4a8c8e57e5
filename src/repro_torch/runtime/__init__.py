"""Runtime pieces of the serving paths: the §12 fault-injection harness
(`fault`), the device probes of the elastic pool (`elastic`) and the LM
prefill / decode steps (`serve_lib`)."""
