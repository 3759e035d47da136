"""Host utilities of the port: device resolution, native builds, metrics."""
