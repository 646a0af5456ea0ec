"""bench_port.drivers"""
