"""Service configuration, logging, profiling and the serving census."""
