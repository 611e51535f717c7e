"""One module per kind of entry a traffic file can drive (its ``driver``
key): each builds the port's objects from a configuration, draws the
traffic from the seed, warms up, runs the measured window, runs a traced
slice and checks what the window produced against the reference."""
