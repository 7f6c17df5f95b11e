"""The open-loop load generator of the `serve` driver, run as a child
process that imports no torch:

    python3 -m cirbench.loadgen <plan.json> <results.json>

The plan gives the server's port, the start time on the shared monotonic
clock, and per query its due time (seconds after the start) and its JSON
body. One thread runs an asyncio loop: each query opens its own connection
when it is due, whatever the others are doing, and is timed from its due
time to its last byte.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import sys
import time


def send(port: int, body: bytes, timeout: float):
    """One blocking POST to /retrieve: (status, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/retrieve", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


async def _post(port: int, body: bytes) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"POST /retrieve HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\nConnection: close\r\n\r\n%s"
                     % (len(body), body))
        await writer.drain()
        status_line = await reader.readline()
        length = 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b""):
                break
            name, _, value = line.decode().partition(":")
            if name.strip().lower() == "content-length":
                length = int(value)
        data = await reader.readexactly(length)
        return int(status_line.split()[1]), data
    finally:
        writer.close()


async def _run(plan: dict) -> list:
    port, start, timeout = plan["port"], plan["start"], plan["timeout_s"]
    keep = set(plan["keep"])
    records = [None] * len(plan["queries"])

    async def one(i: int, due: float, body: bytes):
        await asyncio.sleep(max(0.0, due - time.monotonic()))
        sent = time.monotonic()
        try:
            status, data = await asyncio.wait_for(_post(port, body), timeout)
        except (OSError, asyncio.TimeoutError, ValueError,
                asyncio.IncompleteReadError) as exc:
            status, data = -1, repr(exc).encode()
        done = time.monotonic()
        rec = {"due": due - start, "late": sent - due, "latency": done - due,
               "status": status}
        if i in keep or status != 200:
            rec["body"] = data.decode(errors="replace")
        records[i] = rec

    await asyncio.gather(*(one(i, start + q["due"],
                               json.dumps(q["body"]).encode())
                           for i, q in enumerate(plan["queries"])))
    return records


def main(plan_path: str, out_path: str) -> int:
    with open(plan_path) as fh:
        plan = json.load(fh)
    records = asyncio.run(_run(plan))
    with open(out_path, "w") as fh:
        json.dump(records, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
