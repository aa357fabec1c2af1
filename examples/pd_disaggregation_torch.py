"""PD-disaggregated serving on the PyTorch port (§4.5; the twin of
``examples/pd_disaggregation.py``): a prefill TE computes prompt KV and
hands each finished prompt to a decode TE over the port's DistFlow (by-req
transfer), end to end.

    PYTHONPATH=src python examples/pd_disaggregation_torch.py
    PYTHONPATH=src python examples/pd_disaggregation_torch.py --smoke \\
        --device cpu
(full width h2o-danube-3-4b in bf16 with random weights on the card by
default; ``--smoke`` takes the reduced config.)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.engine import (EngineConfig, FlowServe,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config instead of full width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype, dev)
    tok = ByteTokenizer(max(cfg.vocab_size, 259))

    def ecfg(mode):
        return EngineConfig(mode=mode, n_pages=128, page_size=8,
                            max_batch_tokens=64, chunk_size=16,
                            max_decode_batch=8, dtype=dtype)
    prefill_te = FlowServe(cfg, params, ecfg("prefill"), name="te-prefill-0",
                           device=dev)
    decode_te = FlowServe(cfg, params, ecfg("decode"), name="te-decode-0",
                          device=dev)
    prefill_te.distflow.link_cluster([decode_te.distflow])
    print(f"[pd] {cfg.name} ({cfg.n_layers} layers, {dtype}) on {dev}: "
          f"linked prefill TE <-> decode TE (DistFlow M:N channel)")

    sp = SamplingParams(temperature=0.0, max_new_tokens=24, stop_on_eos=False)
    prompts = [f"pd-disaggregation request number {i}: compute my kv cache"
               for i in range(4)]
    for p in prompts:
        prefill_te.add_request(Request(prompt_tokens=tok.encode(p),
                                       sampling=sp))

    comps, migrated = [], 0
    t0 = time.monotonic()
    while (prefill_te.has_work() or decode_te.has_work()
           or prefill_te._prefill_done_buffer):
        prefill_te.step()
        for rid in prefill_te.pop_migratable():
            # the page run moves device to device in layer chunks; the
            # decode TE scatters them just before the sequence's first
            # decode step
            prefill_te.migrate_out(rid, decode_te)
            xfer = prefill_te.distflow.log[-1]
            migrated += 1
            print(f"[pd] migrated {rid}: {xfer.n_bytes / 1e3:.1f} KB KV over "
                  f"{xfer.backend}x{xfer.links} links "
                  f"(sim {xfer.sim_seconds * 1e6:.0f}us)")
        comps.extend(decode_te.step())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[pd] {migrated} migrations, {len(comps)} completions "
          f"in {time.monotonic() - t0:.2f}s")
    for c in comps:
        print(f"  - {c.req_id}: {tok.decode(c.tokens)[:40]!r}")
    print(f"[pd] launches: prefill TE {prefill_te.kernel_launches}, "
          f"decode TE {decode_te.kernel_launches}")
    assert migrated == len(prompts) == len(comps)


if __name__ == "__main__":
    main()
