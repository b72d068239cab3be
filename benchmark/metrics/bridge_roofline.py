"""The host bridge's copies against the host link: the least time of a
step's copies, each direction's bytes (the recipe's ``copy_work``) over
64 GB/s, over the device time a step of the ``Memcpy HtoD`` launched under
``xtt.bridge.to_device`` and the ``Memcpy DtoH`` launched under
``xtt.bridge.to_host``, in %.  Each copy is counted on its own, so the share
stays under 100 % whether or not the two directions overlap."""

LINK_BYTES_PER_S = 64e9  # H100 SXM5's PCIe Gen5 x16 link, one direction
COPIES = (("xtt.bridge.to_device", "Memcpy HtoD"), ("xtt.bridge.to_host", "Memcpy DtoH"))


def read(trace, cell):
    copy_work = getattr(cell.recipe, "copy_work", None)
    ops = [o for span, name in COPIES for o in trace.ops_under(span, (name,))]
    if copy_work is None or not ops or trace.steps == 0:
        return None
    least_ms = sum(copy_work(cell.shapes).values()) / LINK_BYTES_PER_S * 1e3
    measured_ms = sum(o.dur_us for o in ops) / 1e3 / trace.steps
    print(f"bridge: least {least_ms:.6f} ms a step at {LINK_BYTES_PER_S / 1e9:g} GB/s, "
          f"measured {measured_ms:.6f} ms in {len(ops) / trace.steps:g} copies a step "
          f"[{cell.card}]", flush=True)
    if measured_ms <= 0:
        return None
    return 100.0 * least_ms / measured_ms
