"""Training path of the port: trainer, checkpoint, input pipeline, loop and CLI."""
