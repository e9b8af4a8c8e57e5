"""Runtime pieces: the §12 fault-injection harness and the crash-safe
training loop (`fault`), the device probes of the elastic pool
(`elastic`), the LM prefill / decode steps (`serve_lib`) and the train
step (`train_lib`)."""
