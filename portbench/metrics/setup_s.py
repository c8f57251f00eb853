"""Seconds from the start of the process to the first timed tick."""


def read(rec):
    return rec["setup_s"]
