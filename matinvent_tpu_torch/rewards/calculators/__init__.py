"""Host-side property calculators of the port. Only the empirical ones are
ported; the predictor, synthesizability, DFT, MLIP and ALIGNN calculators of
the JAX package are not, and nothing here imports them."""
