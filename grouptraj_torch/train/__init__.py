"""Training-side modules of the port: checkpoint loading, the
device-resident batch gather and the d/g training steps."""
