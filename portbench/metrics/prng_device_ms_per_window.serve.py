"""Device milliseconds a window of the threefry kernel (``core/prng``'s
draws on the card): every device op whose name holds ``threefry_kernel``.
None where the program has no such kernel."""


def read(inputs, window):
    if window is None or not inputs["windows"]:
        return None
    hits = [t for name, (_, t) in window.by_kernel().items()
            if "threefry_kernel" in name]
    return sum(hits) * 1e3 / inputs["windows"] if hits else None
