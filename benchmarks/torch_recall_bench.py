"""Recall of the port's estimators against the exact float32 top-k, on one GPU.

The port of ``benchmarks/recall_bench.py`` to ``lshrs_tpu_torch``: the same
arguments, data, columns and one JSON row per threshold. It measures
recall@k of collision counting (kernel B1), full-signature Hamming and
asymmetric ranking (kernel B2) and the cosine-reranked top-p against
brute-force search on synthetic clustered (or GloVe-like heavy-tailed)
data, sweeping the auto-tuner's similarity threshold, whose bandings set
B1's band words: 0.4 -> 64 x 4, 0.6 -> 32 x 8, 0.8 -> 16 x 16, 0.9 -> 8 x
32, 0.95 -> 4 x 64 at ``num_perm=256``.

The data are the reference's to the bit (the same NumPy generators and
``default_rng(7)`` draws), and both packages hash with
``hash_mode="host"`` in NumPy from ``default_rng(seed)`` projections, so
the store words are the reference's too. The ground truth is this
script's own: a normalised float32 product on the card with TF32 off (raw
inner products for ``--similarity dot``), then ``torch.topk``, in query
blocks that bound the ``(Q, N)`` temporary. The reference's truth used a
TPU's default-precision ``jnp.dot``, so its tables are not targets.

Usage, from the repository root:

    python3 benchmarks/torch_recall_bench.py [--n 1048576] [--dim 256] \\
        [--thresholds 0.4 0.6 0.8 0.9 0.95] [--rerank] [--multiprobe 4] \\
        [--hash-family gaussian|structured|crosspolytope] [--retrain ITERS] \\
        [--similarity cosine|dot] [--payload-dtype float32|bfloat16|int8] \\
        [--bands B --rows R] [--dist clustered|heavy] [--source x.npy] \\
        [--smoke] [--device cuda|cpu]

Prints one JSON line per threshold: the reference's fields, plus the card
(``nvidia-smi`` name and power limit), the top-p engine the rerank
columns took, and each column's kernel launches. On the card the
collision columns must launch B1, the Hamming and asymmetric columns B2,
and a rerank on the gather engine B1; a launch that does not happen
prints ``{"check_failed": ...}`` on stderr and exits 1.

``--smoke`` cuts sizes only: 16,384 base vectors, 64 queries, the five
thresholds above, ``--rerank`` and ``--multiprobe 2``. ``--device cpu``
runs the same paths on CPU tensors (the kernels' plain versions; no
launch is counted there).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

B1, B2, B3 = "group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys"
SMOKE = dict(n=16384, queries=64, thresholds=[0.4, 0.6, 0.8, 0.9, 0.95], rerank=True,
             multiprobe=2)
# Elements of one query block's (Q, N) float32 similarity matrix.
TRUTH_BLOCK_ELEMENTS = 1 << 28


class CheckFailed(Exception):
    """A check of the run failed: the run exits 1 and names it."""

    def __init__(self, name: str, detail):
        super().__init__(f"{name}: {detail}")
        self.name, self.detail = name, detail


def check(ok: bool, name: str, detail) -> None:
    if not ok:
        raise CheckFailed(name, detail)


def counts_launches(device: torch.device) -> bool:
    """Whether the kernel wrappers count launches on ``device`` (on CPU
    tensors their plain versions run and nothing is counted)."""
    return device.type == "cuda"


def kernel_launches() -> dict:
    from lshrs_tpu_torch.ops import group_max as gm

    return {B1: gm.group_max_keys.launches, B2: gm.hamming_group_max_keys.launches,
            B3: gm.hamming_packed_group_max_keys.launches}


def card(device: torch.device) -> dict:
    """``nvidia-smi``'s name and power limit of the card (``cpu`` on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def make_clustered(n: int, dim: int, n_clusters: int, rng) -> np.ndarray:
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + 0.35 * rng.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32)


def make_heavy_tailed(n: int, dim: int, n_clusters: int, rng) -> np.ndarray:
    """GloVe-like embeddings: Zipf cluster sizes, anisotropic axis scales
    (a few huge neighbourhoods, a long tail of tiny ones, variance in the
    leading directions)."""
    sizes = 1.0 / np.arange(1, n_clusters + 1)  # Zipf(1) cluster mass
    probs = sizes / sizes.sum()
    assign = rng.choice(n_clusters, size=n, p=probs)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    axis_scale = (1.0 / np.sqrt(np.arange(1, dim + 1))).astype(np.float32)
    noise = rng.standard_normal((n, dim)).astype(np.float32) * axis_scale[None, :]
    x = centers[assign] * axis_scale[None, :] * 3.0 + 0.5 * noise
    return x.astype(np.float32)


def exact_topk_device(base: np.ndarray, queries: np.ndarray, k: int, metric: str = "cosine",
                      device: torch.device | str = "cuda") -> np.ndarray:
    """Brute-force top-k ids on ``device``: the base uploaded once, a
    float32 product per query block with TF32 off (cosine: both sides
    normalised; ``dot``: raw inner products), then ``torch.topk``."""
    device = torch.device(device)
    b = torch.from_numpy(np.ascontiguousarray(base, dtype=np.float32)).to(device)
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
    if metric != "dot":
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    step = max(1, TRUTH_BLOCK_ELEMENTS // b.shape[0])
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = [torch.topk(q[s : s + step] @ b.T, k, dim=1).indices.cpu()
               for s in range(0, q.shape[0], step)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return torch.cat(out).numpy()


def recall(got_rows, gt: np.ndarray, k: int) -> float:
    return float(
        np.mean(
            [
                len(set(int(i) for i in row) & set(t.tolist())) / k
                for row, t in zip(got_rows, gt)
            ]
        )
    )


def _launched(before: dict, column: str, device, launches: dict, **need) -> None:
    """Record the launches since ``before`` under ``column``; on a device
    that counts them, each kernel of ``need`` must have launched."""
    if not counts_launches(device):
        return
    after = kernel_launches()
    got = {name: after[name] - before[name] for name in after}
    launches[column] = got
    for name, n in need.items():
        check(got[name] >= n, f"{column}_launches_{name}", got)


def run_threshold(base, queries, gt, threshold, args) -> dict:
    from lshrs_tpu_torch import LSHRS

    device = torch.device(getattr(args, "device", "cuda"))
    is_cp = args.hash_family == "crosspolytope"
    lsh = LSHRS(
        dim=args.dim,
        num_perm=args.num_perm,
        num_bands=args.bands,
        rows_per_band=args.rows,
        similarity_threshold=threshold,
        store_vectors=args.rerank or args.retrain > 0,
        # bit-semantic estimators (Hamming / asymmetric) are undefined over
        # cross-polytope argmax symbols and rejected at construction
        enable_hamming=not is_cp,
        initial_capacity=1 << max(14, (args.n - 1).bit_length()),
        hash_mode="host",
        hash_family=args.hash_family,
        dedupe=False,
        similarity=args.similarity,
        max_norm=getattr(args, "_max_norm", None),
        payload_dtype=args.payload_dtype,
        # Pinned: the columns are labelled by estimator, and engine="auto"
        # ranks query_batch by Hamming past 512k slots.
        engine="collision",
        device=device,
    )
    t0 = time.perf_counter()
    lsh.index(np.arange(args.n), base)
    build_s = time.perf_counter() - t0
    itq_info = None
    if args.retrain > 0:
        # ITQ-learned hyperplanes fitted on the indexed payload, the
        # signatures rebuilt in place: every column then measures the
        # learned family at the same memory and banding.
        t0 = time.perf_counter()
        itq_info = lsh.retrain(iters=args.retrain)
        itq_info["retrain_s"] = time.perf_counter() - t0
    stats = lsh.stats()
    store = lsh._storage
    launches: dict = {}

    k = args.k
    before = kernel_launches()
    t0 = time.perf_counter()
    got = lsh.query_batch(queries, top_k=k)
    query_s = time.perf_counter() - t0
    _launched(before, "collision", device, launches, **{B1: 1})
    r_coll = recall(got, gt, k)

    q_aug = lsh._augment_query(queries)
    out = {
        "threshold": threshold,
        "family": "learned(itq)" if args.retrain > 0 else args.hash_family,
        "bands": f"{stats['num_bands']}x{stats['rows_per_band']}",
        f"recall@{k}_collision": r_coll,
        "build_s": build_s,
        "query_batch_s": query_s,
        "signature_mb": stats["index"]["signature_bytes"] / 2**20,
    }
    if not is_cp:
        # Hamming (full-signature) recall: the same host hash as indexing
        # (store calls bypass the orchestrator, so the MIPS augmentation is
        # applied here; identity for cosine)
        qwords = lsh._hasher.hash_batch_words_host(q_aug)
        before = kernel_launches()
        _, ham_ids = store.query_hamming(qwords, k)
        _launched(before, "hamming", device, launches, **{B2: 1})
        out[f"recall@{k}_hamming"] = recall([row[row >= 0] for row in ham_ids], gt, k)

        # asymmetric SimHash recall: the query keeps quantised coordinates
        before = kernel_launches()
        asym_rows = lsh.query_asymmetric_batch(queries, top_k=k)
        _launched(before, "asymmetric", device, launches, **{B2: 1})
        out[f"recall@{k}_asymmetric"] = recall([[i for i, _ in row] for row in asym_rows], gt, k)
        # the bitplanes cost num_perm bytes a vector beside the packed words
        out["hamming_extra_mb"] = stats["index"]["capacity"] * args.num_perm / 2**20
    if itq_info is not None:
        out["itq"] = {key: itq_info[key]
                      for key in ("fitted_bits", "padded_bits", "bit_bias", "retrain_s")}

    rerank_engine = None
    if args.rerank:
        rerank_engine = store._resolve_rerank_engine(None, None, q=len(queries))[0]
        gather = {B1: 1} if rerank_engine == "gather" else {}
        before = kernel_launches()
        scored = lsh.get_above_p_batch(queries, p=1.0, top_k=k)
        _launched(before, "reranked", device, launches, **gather)
        out[f"recall@{k}_reranked"] = recall([[i for i, _ in row] for row in scored], gt, k)

    if args.multiprobe > 1:
        # Multi-probe collision (and rerank): the same index, the T-probe
        # query words through every fused query path.
        t_probe = min(args.multiprobe, lsh._hasher.max_probes)
        qw_mp = lsh._hasher.hash_batch_probe_words_host(q_aug, t_probe)
        before = kernel_launches()
        _, mp_ids = store.query_topk(qw_mp, k)
        _launched(before, f"collision_mp{t_probe}", device, launches, **{B1: 1})
        out[f"recall@{k}_collision_mp{t_probe}"] = recall([row[row >= 0] for row in mp_ids], gt, k)
        if args.rerank:
            before = kernel_launches()
            ids_r, _, n_r = store.query_topp_batch(qw_mp, q_aug, k)
            _launched(before, f"reranked_mp{t_probe}", device, launches, **gather)
            out[f"recall@{k}_reranked_mp{t_probe}"] = recall([row[row >= 0] for row in ids_r], gt, k)
    out["rerank_engine"] = rerank_engine
    out["launches"] = launches if counts_launches(device) else None
    lsh._storage.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--bands", type=int, default=None,
                    help="force the banding instead of the threshold auto-tuner (with --rows; "
                    "bands*rows == num-perm)")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--thresholds", type=float, nargs="+", default=[0.8])
    ap.add_argument("--payload-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
                    help="resident payload precision for the rerank rows")
    ap.add_argument("--rerank", action="store_true",
                    help="also measure cosine-reranked recall (the payload rows on the card)")
    ap.add_argument("--multiprobe", type=int, default=1,
                    help="also measure T-probe collision (and reranked, with --rerank) recall "
                    "at this probe depth")
    ap.add_argument("--similarity", choices=["cosine", "dot"], default="cosine",
                    help="'dot' switches the index to MIPS mode (simple-LSH augmentation) and "
                    "ranks the ground truth by inner product; base vectors get a 3x norm spread")
    ap.add_argument("--hash-family", choices=["gaussian", "structured", "crosspolytope"],
                    default="gaussian",
                    help="LSH projection family (structured = FWHT rotations; crosspolytope = "
                    "signed-argmax symbols, collision / rerank estimators only)")
    ap.add_argument("--retrain", type=int, default=0, metavar="ITERS",
                    help="fit ITQ learned hyperplanes on the indexed payload (ITERS "
                    "alternations) and rebuild the signatures in place before measuring "
                    "(implies store_vectors)")
    ap.add_argument("--dist", choices=["clustered", "heavy"], default="clustered",
                    help="base-data generator: Gaussian-mixture clusters or GloVe-like "
                    "heavy-tailed (Zipf clusters, anisotropic axes)")
    ap.add_argument("--source", default=None,
                    help="path to real embeddings (.npy 2-D float array, or .npz whose first "
                    "array is one); overrides --dist/--dim/--n; the last --queries rows are "
                    "held out as queries and the rest are indexed")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes (16,384 vectors, 64 queries), the five sweep thresholds, "
                    "--rerank and --multiprobe 2")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_recall_bench: no CUDA device available (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        from lshrs_tpu_torch.ops import _build

        _build.library()

    rng = np.random.default_rng(7)
    if args.source:
        arr = np.load(args.source, allow_pickle=False)
        if hasattr(arr, "files"):  # .npz: take the first array
            arr = arr[arr.files[0]]
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[0] <= args.queries:
            raise SystemExit(
                f"--source must be a 2-D array with more than {args.queries} rows; "
                f"got shape {arr.shape}"
            )
        # drop exact-zero rows (unindexable), then hold out the queries
        arr = arr[np.abs(arr).max(axis=1) > 1e-8]
        base, queries = arr[: -args.queries], arr[-args.queries :]
        args.n, args.dim = base.shape
        dist_label = f"source:{Path(args.source).name}"
    else:
        gen = make_clustered if args.dist == "clustered" else make_heavy_tailed
        base = gen(args.n, args.dim, n_clusters=max(1000, args.n // 1000), rng=rng)
        if args.similarity == "dot":
            # the augmentation's hard case: a 3x stored-norm spread
            base *= rng.uniform(0.5, 1.5, (args.n, 1)).astype(np.float32)
        q_idx = rng.permutation(args.n)[: args.queries]
        queries = base[q_idx] + 0.05 * rng.standard_normal((args.queries, args.dim)).astype(np.float32)
        dist_label = args.dist

    if args.similarity == "dot":
        args._max_norm = float(np.linalg.norm(base, axis=1).max()) * 1.001
    gt = exact_topk_device(base, queries, args.k, metric=args.similarity, device=device)

    label = card(device)
    try:
        for t in args.thresholds:
            row = run_threshold(base, queries, gt, t, args)
            row.update({
                "n": args.n, "dim": args.dim, "num_perm": args.num_perm,
                "dist": dist_label, "similarity": args.similarity, "device": label,
            })
            print(json.dumps(row), flush=True)
    except CheckFailed as exc:
        print(json.dumps({"check_failed": exc.name, "detail": str(exc.detail)}), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
