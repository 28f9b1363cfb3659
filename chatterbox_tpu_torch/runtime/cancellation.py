"""Request cancellation token (a copy of ``chatterbox_tpu.runtime.cancellation``;
same contract as the reference CancellationToken,
reference src/tts_streaming.py:88-104)."""
from __future__ import annotations

import asyncio


class CancellationToken:
    def __init__(self):
        self._event = asyncio.Event()

    def cancel(self) -> None:
        self._event.set()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        await self._event.wait()


async def race_cancellation(coro, token: CancellationToken):
    """Await `coro` unless the token fires first. Returns (cancelled, result).

    The losing task is cancelled AND reaped (awaited), so no pending-task
    debris survives to loop teardown."""
    get_task = asyncio.ensure_future(coro)
    cancel_task = asyncio.ensure_future(token.wait())
    try:
        done, pending = await asyncio.wait(
            [get_task, cancel_task], return_when=asyncio.FIRST_COMPLETED
        )
    except BaseException:
        get_task.cancel()
        cancel_task.cancel()
        raise
    for t in pending:
        t.cancel()
        try:
            await t
        except (asyncio.CancelledError, Exception):
            pass
    if cancel_task in done and get_task not in done:
        return True, None
    return False, get_task.result()
