"""The bytes the traced slice's decode steps needed from the paged caches
(every live slot's rows, each layer, read once; the query rows read and
the output rows written), over HBM bandwidth, over the device time of the
decode-attention kernel (paged and latent flash-decode share it)."""
from bench.lib import peaks

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "output_tokens_per_s"
KERNELS = ("flash_decode_slot_kernel",)


def needed_bytes(run) -> float:
    row, qo = run.ref.decode_attention_elems(run.config)
    L = int(run.config["num_hidden_layers"])
    kv = sum(call.kv_rows for call in run.calls if call.traced)
    q = sum(sum(call.dec_rows) for call in run.calls if call.traced)
    return 2.0 * L * (kv * row + q * qo)


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    dev = run.trace.seconds(run.trace.ops_named(KERNELS))
    need = needed_bytes(run)
    if dev <= 0 or need <= 0:
        return None
    return 100.0 * need / peaks.HBM_BW / dev
