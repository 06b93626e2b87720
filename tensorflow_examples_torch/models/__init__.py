"""GPT-2 model and the weight bridge to and from the JAX param tree."""
