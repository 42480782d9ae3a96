"""A frozen plain reference of LOAM: a NumPy transcription of the four
nodes of the C++ (scanRegistration, laserOdometry, laserMapping,
transformMaintenance; Zhang and Singh, RSS 2014), composed the way the
ROS graph runs them.  It imports nothing of the program under test and
nothing of the repository's tests: only NumPy.  Sequential and
deliberately plain, fidelity over speed."""
