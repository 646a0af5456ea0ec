"""bench_port.tests"""
