"""Device ops of the port: the mel frontend and the hand-written kernels."""
