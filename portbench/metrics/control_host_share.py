"""Share of the window the host spends in control rounds (reading the
counters, checking and refilling finished lanes), outside the fleet's
runs: the benchmark's own spans around its calls into ``Fleet``, in %."""


def read(rec):
    control = sum(s for name, s in rec["spans"] if name == "control")
    return 100.0 * control / rec["window_s"]
