"""Simulated instructions a second: every instruction that any hart
retired in the window, over the window's host seconds, in millions."""


def read(rec):
    return rec["retired"] / rec["window_s"] / 1e6
