"""GPT-2 model and the weight bridge from the JAX param tree."""
