"""90th percentile latency, from submission to the last token, of the
requests that completed in the window."""
import statistics


def read(obs):
    lat = obs.get("latencies")
    if not lat or len(lat) < 10:
        return None
    return statistics.quantiles(lat, n=10)[-1]
