from benchmark.readers import idle_pct as read  # noqa: F401
