"""The host's ``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` /
``cudaEventSynchronize`` calls a traced request, inside the program's
``rscotr.request.*`` span: each a wait for the card's queue to drain. The
read-back after the entry returns lies outside."""

from bench_h100 import spans


def read(run):
    return spans.host_syncs(run)
