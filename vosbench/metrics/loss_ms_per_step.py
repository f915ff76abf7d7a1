"""Device ms a train step spends in its loss (the head: the annotations'
downsample and quantisation, the one-hot labels, the loss and its
miners): the program's span ``train.loss`` inside ``train.step``, timed on
the card by CUDA events, per ``train.step`` of the traced slice; None on
the CPU, where nothing is timed on a card."""

from vosbench.spans import device_ms_per_step


def read(_slice):
    return device_ms_per_step("train.loss")
