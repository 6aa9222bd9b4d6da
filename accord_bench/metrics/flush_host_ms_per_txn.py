"""The flush's host work: the store's ``*_encode`` and ``*_decode``
profiler laps (``BatchEncoder``, the wave plan's encoding, the masks'
decoding) summed over the window, in ms a transaction applied."""


def read(run):
    if not run.laps_s or not run.txns:
        return None
    return sum(s for name, s in run.laps_s.items()
               if name.endswith(("_encode", "_decode"))) * 1e3 / run.txns
