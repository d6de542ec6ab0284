from .tables import RateTables, build_rate_tables  # noqa: F401
