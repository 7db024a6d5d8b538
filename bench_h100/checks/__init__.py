"""The comparisons that decide ``correct``, one module per serving entry,
found by the name a workload file gives under ``check``.

Each module has ``reference(imgs, P, mcfg, mode, traffic)``: the plain
forward of ``reference/mtl.py`` over the same uint8 inputs, in the
program's output format (``"fp8"`` gives the control), and
``compare(imgs, outs, P, mcfg, traffic)``: the numbers that a workload's
``limits`` bound, taken against the float32 reference. For the serve
driver it also has ``prepare(model, fn, traffic, keep) -> call(pixels)``,
``to_host(out) -> {name: tensor}`` and ``count(mcfg, traffic) -> (flops,
{kernel: [call shapes]})`` of one request, so that a new entry adds a
module here and edits nothing.
"""
