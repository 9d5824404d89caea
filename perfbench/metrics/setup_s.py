"""Set-up: from the process's start to the window's opening (imports,
the card's start, the seed's weights and inputs, the warm-up and, in a
training cell, the first steps with the capture)."""
LAYER, UNIT, SOURCE = None, "s", "host_clock"


def read(facts):
    return facts["setup_s"]
