"""The plain reference: a decoder-only LM in float32 PyTorch (TF32 off),
written from the published description, in blocks so that it fits beside
the port's outputs.  Imports nothing of the port."""
