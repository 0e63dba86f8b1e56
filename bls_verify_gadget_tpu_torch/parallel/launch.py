"""Rank launcher of the parallel layer and its multi-rank dry run.

run_ranks(n, target, ...) starts n ranks as fresh interpreters (never
forked, so no rank inherits an initialised CUDA context), each running

    python -m bls_verify_gadget_tpu_torch.parallel.launch --rank R --world N
        --port PORT --device DEV [--backend B] --target MODULE:FUNCTION
        [--arg JSON]

which joins the process group on localhost:PORT (distributed.initialize),
makes the mesh of all N ranks, calls FUNCTION(mesh, arg) and prints its
result, a JSON object, as the last line of its output.  A rank that raises
exits non-zero; the launcher then stops the others and raises, as it does
when the ranks outlive its time limit.  On a card the launcher builds the
kernels first, so that the ranks load one library instead of racing nvcc.

dryrun_multichip(n, device) is the port's counterpart of the JAX package's
multi-chip dry run (__graft_entry__.dryrun_multichip): one staged sharded
verify of a valid signature tiled to
one element per rank, then the masked aggregate with one set bit, held to
that pubkey.  From the command line:

    python -m bls_verify_gadget_tpu_torch.parallel.launch --dryrun 2 --device cpu
"""

import argparse
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ..ops.fp import resolve_device

PKG_ROOT = pathlib.Path(__file__).resolve().parents[2]  # the directory holding the package

# verify/verify_valid_case_195246ee3bd3b6ec of the ETH2 BLS test vectors
VALID_PK = ("b53d21a4cfd562c469cc81514d4ce5a6b577d8403d32a394dc265dd190b47fa9"
            "f829fdd7963afdf972e5e77854051f6f")
VALID_MSG = "ab" * 32
VALID_SIG = ("ae82747ddeefe4fd64cf9cedb9b04ae3e8a43420cd255e3c7cd06a8d88b7c7f8"
             "638543719981c5d16fa3527c468c25f0026704a6951bde891360c7e8d12ddee0"
             "559004ccdbe6046b55bae1b257ee97f7cdb955773d7cf29adf3ccbb9975e4eb9")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n: int, target: str, arg=None, device: str = "cuda", backend: str | None = None,
              timeout: float = 600.0, path=()):
    """Run target ("module:function", called as function(mesh, arg) on
    every rank) in n fresh rank processes -> their results, in rank
    order.  The ranks run on the card unless device="cpu".  `path`:
    directories the ranks import from besides the package's.  Raises
    RuntimeError if a rank fails or the ranks outlive `timeout` seconds;
    no rank is left running."""
    if resolve_device(device).type == "cuda":
        from ..ops import kernels as K

        K.library()
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(PKG_ROOT), *map(str, path), os.environ.get("PYTHONPATH", "")])}
    with tempfile.TemporaryDirectory(prefix="bls_ranks_") as tmp:
        procs, outs = [], []
        try:
            for r in range(n):
                cmd = [sys.executable, "-m", "bls_verify_gadget_tpu_torch.parallel.launch",
                       "--rank", str(r), "--world", str(n), "--port", str(port),
                       "--device", device, "--target", target, "--arg", json.dumps(arg)]
                if backend:
                    cmd += ["--backend", backend]
                out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
                err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
                outs.append((out, err))
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = any(p.poll() not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        report = "\n".join(f"--- rank {r} (rc {rc}) ---\n{o[-2000:]}\n{e[-4000:]}"
                           for r, (rc, (o, e)) in enumerate(zip(rcs, texts)))
        raise RuntimeError(f"{target} on {n} ranks failed or timed out after {timeout} s "
                           f"(return codes {rcs}):\n{report}")
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in texts]


def _rank_main(args):
    from .distributed import initialize
    from .mesh import make_mesh

    import torch.distributed as dist

    initialize(f"localhost:{args.port}", args.world, args.rank, args.device, args.backend)
    mesh = make_mesh(args.world, device=torch.device(args.device).type)
    module, name = args.target.split(":")
    result = getattr(importlib.import_module(module), name)(mesh, json.loads(args.arg))
    dist.destroy_process_group()
    print(json.dumps({"rank": args.rank, **result}), flush=True)


def dryrun_rank(mesh, arg):
    """One rank of dryrun_multichip: the valid signature as this rank's
    slab of one element."""
    import torch.distributed as dist

    from ..golden import codec
    from ..models.bls import BatchedBLS, encode_messages, encode_pubkeys, encode_signatures
    from ..ops import curve as CV
    from .api import _keep, make_sharded_verify_staged, sharded_masked_aggregate

    dev = mesh.device_type
    rank, world = dist.get_rank(), dist.get_world_size()
    bls = BatchedBLS(device=dev)
    pk_pt = codec.g1_decompress(bytes.fromhex(VALID_PK))
    pk = encode_pubkeys([pk_pt], dev)
    sig = encode_signatures([codec.g2_decompress(bytes.fromhex(VALID_SIG))], dev)
    msg = encode_messages([bytes.fromhex(VALID_MSG)], dev)
    ok = make_sharded_verify_staged(bls, mesh, len(VALID_MSG) // 2)(pk, sig, msg)
    if ok.tolist() != [True] * world:
        raise RuntimeError(f"sharded verify of the valid signature gave {ok.tolist()}")
    pk_jac = CV.pt_from_affine(CV.FP_OPS, *pk)
    bitmap = torch.tensor([int(rank == 0)], dtype=torch.int32, device=dev)
    apk, count = sharded_masked_aggregate(mesh, pk_jac, bitmap)
    if int(count) != 1 or CV.g1_decode(_keep(apk)) != [pk_pt]:
        raise RuntimeError(f"masked aggregate with one set bit: count {int(count)}, "
                           f"point {CV.g1_decode(_keep(apk))} != the signer's pubkey")
    return {"verify": ok.tolist(), "count": int(count), "world": world, "device": dev}


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 600.0):
    """dryrun_rank on n ranks: NCCL on "cuda" (one card per rank), Gloo on
    "cpu".  Prints each rank's result; raises if any rank fails."""
    if resolve_device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"dryrun_multichip({n}, 'cuda') needs {n} cards, "
                         f"this host has {torch.cuda.device_count()}")
    results = run_ranks(n, "bls_verify_gadget_tpu_torch.parallel.launch:dryrun_rank",
                        device=device, timeout=timeout)
    for res in results:
        print(json.dumps(res), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N", help="run dryrun_multichip on N ranks")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--device", default="cuda", help='"cuda" (the default) or "cpu"')
    ap.add_argument("--backend")
    ap.add_argument("--target")
    ap.add_argument("--arg", default="null")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    try:
        _rank_main(args)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # skip exit handlers that could wait on a broken collective
    return 0


if __name__ == "__main__":
    sys.exit(main())
