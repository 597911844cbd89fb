"""Weight carry between the JAX params tree and the port's state dicts."""
