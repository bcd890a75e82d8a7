"""Training of the port: losses, the optimizer and the train step."""
