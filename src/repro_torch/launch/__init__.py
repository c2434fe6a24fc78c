"""The training step builders and ``train()``, the resumable training
loop."""
