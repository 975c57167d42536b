from .sysinfo import cpu_time_s, peak_rss_mb, rss_mb, Timer

__all__ = ["cpu_time_s", "peak_rss_mb", "rss_mb", "Timer"]
