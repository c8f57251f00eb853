"""The card's peak of allocated memory over set-up and the window, GiB."""


def read(rec):
    peak = rec["peak_bytes"]
    return None if peak is None else peak / 2 ** 30
