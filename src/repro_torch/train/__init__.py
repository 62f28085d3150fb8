"""Training of the port on one device: AdamW, the train step, gradient
compression."""
