"""MNIST: schema, generator and the training examples (torch twins)."""
