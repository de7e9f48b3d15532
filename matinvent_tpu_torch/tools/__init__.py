"""Command-line tools (``tools/`` of the JAX package): pretraining and the
corpus, reference-set, predictor-set, histogram and SynScore tools. Each
runs as ``python -m matinvent_tpu_torch.tools.<name> key=value ...`` with
its JAX counterpart's arguments."""
