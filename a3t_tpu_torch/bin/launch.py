"""Mesh launcher: the port of ``a3t_tpu/bin/launch.py`` (the
espnet2.bin.launch analogue, launch.py:93-310).

Fans a training command out as one process per card, appending the flags
that ``a3t_tpu_torch.bin.train`` turns into a ``torch.distributed`` group
(``--coordinator`` / ``--num-hosts`` / ``--host-id``).  Each entry of
``--hosts`` is one process, so a machine with k cards is listed k times;
a mesh of ``dp x sp x tp`` takes ``dp * sp * tp`` entries, rank ``(d * sp
+ s) * tp + t`` being data rank d, seq rank s and model rank t: the ranks
``r .. r + tp - 1`` from a multiple of tp form a model group and the sp * tp
ranks of one data rank follow each other, so list a machine's cards
together.
Three dispatch modes:

* ``ssh``   — one ``ssh host 'cd <cwd> && <cmd>'`` per entry (the
              reference's ssh.pl path);
* ``slurm`` — one ``srun --nodes=1 --ntasks=1 -w host`` per entry inside
              an existing allocation (slurm.pl path);
* ``local`` — every rank as a process of this machine (one per card of
              it, or CPU ranks with ``--device cpu``).

    python -m a3t_tpu_torch.bin.launch --launcher local \
        --hosts localhost,localhost -- \
        python -m a3t_tpu_torch.bin.train --config conf.yaml

The first entry is the coordinator (rank 0 listens at its ``--port``).
The ranks on other machines must see the same experiment directory
(``exp_dir``) as rank 0, on a shared file system: rank 0 writes the
checkpoints and every rank reads them on resume; the trainer stops with
an error on every rank when one of them cannot see rank 0's files.
The exit status is non-zero if any rank fails, and the other ranks are
then terminated (a rank waiting in a collective would wait for ever).
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def build_host_commands(
    hosts: list[str],
    cmd: list[str],
    port: int = 8476,
    launcher: str = "ssh",
    ssh_user: str | None = None,
    cwd: str | None = None,
) -> list[list[str]]:
    """Per-host argv lists with the bootstrap flags appended."""
    coordinator = f"{hosts[0]}:{port}"
    out = []
    for i, host in enumerate(hosts):
        full = list(cmd) + [
            "--coordinator", coordinator,
            "--num-hosts", str(len(hosts)),
            "--host-id", str(i),
        ]
        if launcher == "local":
            out.append(full)
        elif launcher == "ssh":
            target = f"{ssh_user}@{host}" if ssh_user else host
            remote = " ".join(shlex.quote(a) for a in full)
            if cwd:
                remote = f"cd {shlex.quote(cwd)} && {remote}"
            out.append(["ssh", "-o", "BatchMode=yes", target, remote])
        elif launcher == "slurm":
            out.append(["srun", "--nodes=1", "--ntasks=1", f"-w{host}",
                        *full])
        else:
            raise ValueError(f"unknown launcher {launcher!r}")
    return out


def run_commands(cmds: list[list[str]], poll_s: float = 0.2) -> int:
    """Spawn all ranks; poll them all so any rank's failure terminates the
    rest (a sequential wait would hang on an earlier rank stuck in a
    collective while a later one has already died)."""
    import time

    procs = [subprocess.Popen(c) for c in cmds]
    rc = 0
    try:
        pending = set(range(len(procs)))
        while pending:
            for i in sorted(pending):
                r = procs[i].poll()
                if r is None:
                    continue
                pending.discard(i)
                if r != 0 and rc == 0:
                    rc = r
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            if pending:
                time.sleep(poll_s)
    except KeyboardInterrupt:
        for q in procs:
            if q.poll() is None:
                q.terminate()
        rc = 130
    for q in procs:  # reap everything (no zombies)
        q.wait()
    return rc


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="fan a command out as one process per card "
                    "with the data-parallel group's flags",
        usage="%(prog)s --hosts h0,h1[,...] [options] -- cmd [args...]",
    )
    parser.add_argument("--hosts", required=True,
                        help="comma-separated hosts, one entry per process "
                             "(card); the first is the coordinator")
    parser.add_argument("--port", type=int, default=8476)
    parser.add_argument("--launcher", default="ssh",
                        choices=["ssh", "slurm", "local"])
    parser.add_argument("--ssh-user", default=None)
    parser.add_argument("--cwd", default=None,
                        help="remote working dir (default: current)")
    parser.add_argument("--dry-run", action="store_true",
                        help="print the per-host commands and exit")
    if argv is None:
        argv = sys.argv[1:]
    if "--" not in argv:
        parser.error("separate the training command with `--`")
    split = argv.index("--")
    args = parser.parse_args(argv[:split])
    cmd = argv[split + 1:]
    if not cmd:
        parser.error("empty command after `--`")

    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    cmds = build_host_commands(
        hosts, cmd, port=args.port, launcher=args.launcher,
        ssh_user=args.ssh_user, cwd=args.cwd or os.getcwd())
    if args.dry_run:
        for c in cmds:
            print(" ".join(shlex.quote(a) for a in c))
        return 0
    return run_commands(cmds)


if __name__ == "__main__":
    sys.exit(main())
