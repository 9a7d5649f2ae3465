"""Traffic mixes: ``<mix>.json`` holds a mix's parameters and names its
generator, ``<generator>.py`` here, which turns them and a seed into the
same inputs every time."""
