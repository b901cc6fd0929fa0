"""Middleware: rate limiting, request timing, CORS.

Port of ``ocr_system_tpu/api/middleware.py``: the same code, on the port's modules.

Parity targets:
  rate limiter  — in-memory token buckets per client IP, X-Forwarded-For
                  aware, hourly stale-bucket GC, 429 + Retry-After +
                  X-RateLimit-* headers, exclude paths
                  (reference backend/utils/rate_limit.py:37-204)
  timing header — X-Process-Time on every response
                  (reference backend/main.py:186-193)
  CORS          — permissive defaults like the reference dev config
                  (backend/main.py:163-172)
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from ocr_system_tpu_torch.api.http import Request, Response


@dataclass
class RateLimitConfig:
    requests_per_minute: int = 60
    requests_per_hour: int = 1000
    exclude_paths: tuple[str, ...] = ("/", "/health")


@dataclass
class ClientBucket:
    minute_window: float = 0.0
    minute_count: int = 0
    hour_window: float = 0.0
    hour_count: int = 0
    last_seen: float = field(default_factory=time.monotonic)


class RateLimiter:
    """Fixed-window limiter with per-minute and per-hour budgets
    (reference RateLimiter.check_rate_limit, rate_limit.py:99-136)."""

    def __init__(self, config: RateLimitConfig | None = None):
        self.config = config or RateLimitConfig()
        self._buckets: dict[str, ClientBucket] = {}
        self._lock = asyncio.Lock()
        self._last_gc = time.monotonic()

    async def check(self, client_ip: str) -> tuple[bool, int, dict[str, str]]:
        """Returns (allowed, retry_after_s, headers)."""
        now = time.monotonic()
        async with self._lock:
            if now - self._last_gc > 3600:
                self._gc(now)
            b = self._buckets.setdefault(client_ip, ClientBucket())
            b.last_seen = now
            if now - b.minute_window >= 60:
                b.minute_window, b.minute_count = now, 0
            if now - b.hour_window >= 3600:
                b.hour_window, b.hour_count = now, 0
            cfg = self.config
            if b.minute_count >= cfg.requests_per_minute:
                retry = int(60 - (now - b.minute_window)) + 1
                return False, retry, self._headers(b, limited=True)
            if b.hour_count >= cfg.requests_per_hour:
                retry = int(3600 - (now - b.hour_window)) + 1
                return False, retry, self._headers(b, limited=True)
            b.minute_count += 1
            b.hour_count += 1
            return True, 0, self._headers(b)

    def _headers(self, b: ClientBucket, limited: bool = False) -> dict[str, str]:
        cfg = self.config
        return {
            "X-RateLimit-Limit": str(cfg.requests_per_minute),
            "X-RateLimit-Remaining": str(
                max(cfg.requests_per_minute - b.minute_count, 0)
            ),
        }

    def _gc(self, now: float) -> None:
        stale = [k for k, b in self._buckets.items() if now - b.last_seen > 3600]
        for k in stale:
            del self._buckets[k]
        self._last_gc = now


def rate_limit_middleware(limiter: RateLimiter):
    async def mw(request: Request, call_next):
        if request.path in limiter.config.exclude_paths:
            return await call_next(request)
        allowed, retry_after, headers = await limiter.check(request.client_ip)
        if not allowed:
            return Response.json(
                {"detail": "Rate limit exceeded"},
                status=429,
                headers={**headers, "Retry-After": str(retry_after)},
            )
        response = await call_next(request)
        response.headers.update(headers)
        return response

    return mw


def endpoint_rate_limit(limiter: RateLimiter):
    """Per-endpoint limiter decorator (reference rate_limit decorator +
    pre-built OCR/LLM limiters, rate_limit.py:207-253). Wraps a handler:

        @r.post("/api/extractions/{id}")
        @endpoint_rate_limit(ocr_limiter)
        async def start_extraction(req, bg): ...
    """

    def deco(handler):
        import functools

        @functools.wraps(handler)
        async def wrapped(request: Request, *args, **kwargs):
            allowed, retry_after, headers = await limiter.check(request.client_ip)
            if not allowed:
                return Response.json(
                    {"detail": "Rate limit exceeded for this operation"},
                    status=429,
                    headers={**headers, "Retry-After": str(retry_after)},
                )
            response = await handler(request, *args, **kwargs)
            response.headers.update(headers)
            return response

        return wrapped

    return deco


async def timing_middleware(request: Request, call_next):
    t0 = time.perf_counter()
    response = await call_next(request)
    response.headers["X-Process-Time"] = f"{time.perf_counter() - t0:.4f}"
    return response


async def cors_middleware(request: Request, call_next):
    if request.method == "OPTIONS":
        response = Response(status=204)
    else:
        response = await call_next(request)
    response.headers.update(
        {
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "GET, POST, PATCH, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type, Authorization",
        }
    )
    return response
