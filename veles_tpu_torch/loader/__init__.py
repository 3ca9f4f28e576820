"""Minibatch servers: the loader base and the device-resident full-batch
loader."""
