"""Device ms a train step spends in its forward (the network, from the
uint8 clips to features): the program's span ``train.forward`` inside
``train.step``, timed on the card by CUDA events, per ``train.step`` of the
traced slice; None on the CPU, where nothing is timed on a card."""

from vosbench.spans import device_ms_per_step


def read(_slice):
    return device_ms_per_step("train.forward")
