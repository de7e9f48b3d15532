"""On-card harnesses of the port (counterparts of the JAX package's
``experiments/*.py`` harnesses). Each runs with
``python -m matinvent_tpu_torch.experiments.<name>`` and prints one JSON
record; each also runs on the CPU when asked (``main(device="cpu")``), where
it measures no time."""
