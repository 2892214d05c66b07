"""mfu: the least time the UNet's operations could take at the card's
peaks, over the wall time they took: the forwards (of every client) that
ran within the profiled shape, over that shape's wall.  Operations
per forward from benchmark/reference/flops.py: the int8 sites at the
int8 peak when the configuration runs w8a8, every other operation at the
bf16 peak.  With one client this is the least time of a shape's model
work over its seconds; with two, the same over the seconds a shape of the
window takes the card."""


def read(run):
    p = run.profiled
    if not p or not p["forwards"] or p["wall_s"] <= 0:
        return None
    m, peak = run.model, run.peaks
    if run.cell.config["precision"]["unet"] == "w8a8":
        least = (m["site_ops"] / peak["int8_ops_per_s"]
                 + m["float_ops"] / peak["bf16_ops_per_s"])
    else:
        least = (m["site_ops"] + m["float_ops"]) / peak["bf16_ops_per_s"]
    return 100.0 * least * p["forwards"] / p["wall_s"]
