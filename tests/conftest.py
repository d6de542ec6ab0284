import os

from threadpoolctl import threadpool_limits

# numpy's OpenBLAS runs one thread in every test process and in the
# subprocesses the tests start. Its idle threads spin: under pytest-xdist,
# a pool of eight in each of six workers took most of the suite's CPU
# time. numpy is loaded before this file, so its pool is resized in place.
# The stored h2dust factors of tests/answers/rate_tables.npz are those of
# a one-thread OpenBLAS.
os.environ["OPENBLAS_NUM_THREADS"] = "1"
threadpool_limits(1, user_api="blas")
