"""Share of the local update's gradient work that the allocation asked
for, over the profiled round: the ``selected`` attribute of span
``fed.local_update`` (the selected groups' FLOPs summed over clients, per
step) over the mean ``computed`` of its ``local.grad`` spans (the same sum
over the (client, group) gradients that the vmapped step returned). Only
the trainable groups count: the frozen backbone's forward and backward are
paid whatever the allocation."""


def read(obs):
    try:
        from repro_torch import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    ups = [r.attrs["selected"] for r in recs
           if r.name == "fed.local_update" and "selected" in r.attrs]
    grads = [r.attrs["computed"] for r in recs
             if r.name == "local.grad" and "computed" in r.attrs]
    if not ups or not grads or not sum(grads):
        return None
    return 100.0 * (sum(ups) / len(ups)) / (sum(grads) / len(grads))
