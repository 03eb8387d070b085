"""Multi-process runs: the ``torch.distributed`` runtime and its helpers
(:mod:`.dist`), and the global-batch scope of the train steps
(:mod:`.data`)."""
