#!/usr/bin/env python3
"""The port's dry-run records beside the reference's, as a markdown table.

    python tools/dryrun_table.py --reference REF.jsonl --port LABEL=PORT.jsonl ...

``REF.jsonl`` holds ``python -m repro.launch.dryrun --out`` records (the
JAX package's, run where JAX is), each ``PORT.jsonl`` the port's
(``python -m repro_torch.launch.dryrun --out`` or ``tools/dryrun_matrix.py``),
under a label such as the torch that ran it.  One row a pair: per-device
GB (argument + output + temp - alias bytes) and collective bytes of each,
whether each fits the card's 85,017,493,504 bytes, and the port's ratios
to the reference: memory, collective bytes per step, and collective
bytes with each layer stack's unit counted once (``body``), as the
reference's HLO text lists a scanned stack's loop body once.  Reads
nothing but the files; imports neither JAX nor torch.
"""
import argparse
import json

CARD_BYTES = 85_017_493_504


def per_device(rec) -> float:
    m = rec["memory"]
    return (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
            + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])


def load(path):
    out = {}
    for line in open(path):
        rec = json.loads(line)
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", required=True)
    ap.add_argument("--port", nargs="+", required=True, help="LABEL=records.jsonl")
    args = ap.parse_args()
    ref = load(args.reference)
    ports = [(label, load(path)) for label, path in (p.split("=", 1) for p in args.port)]
    head = ["Pair", "Reference GB / coll B (fits)"]
    for label, _ in ports:
        head.append(f"Port {label} GB / coll B (fits)")
        head.append(f"{label} mem × / coll × / body ×")
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    for key, r in ref.items():
        if not any(key in recs for _, recs in ports):
            continue
        rb, rc = per_device(r), sum(r["collective_bytes"].values())
        row = [f"{key[0]} {key[1]} ({key[2]})",
               f"{rb / 1e9:.2f} / {rc:.3g} ({'yes' if rb <= CARD_BYTES else 'no'})"]
        for _, recs in ports:
            p = recs.get(key)
            if p is None or not p.get("ok"):
                row += ["fails" if p else "not run", ""]
                continue
            pb, pc = per_device(p), sum(p["collective_bytes"].values())
            body = sum((p.get("collective_bytes_body_once") or {}).values())
            row.append(f"{pb / 1e9:.2f} / {pc:.3g} ({'yes' if pb <= CARD_BYTES else 'no'})")
            row.append(f"{pb / rb:.2f} / {pc / rc:.2f} / {body / rc:.2f}")
        print("| " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
