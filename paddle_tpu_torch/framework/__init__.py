"""Host-side framework pieces of the port: errors, flags, devices, RNG,
named locks."""
