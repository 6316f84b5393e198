"""Multi-GPU data and vocabulary-head parallelism over torch.distributed
ranks (`parallel.mesh`) and the processes that run them
(`parallel.launch`)."""
