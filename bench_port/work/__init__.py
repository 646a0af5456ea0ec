"""bench_port.work"""
